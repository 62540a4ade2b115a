"""analysis_x_realtime: seconds of audio analysed over the seconds of the
whole window (the window ends when its last request does)."""


def read(view):
    if view.window_s <= 0 or not view.requests:
        return None
    return len(view.requests) * view.audio_s / view.window_s
