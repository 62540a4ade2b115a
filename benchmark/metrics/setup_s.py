"""setup_s: seconds from the run's start to its window's (the import of
torch, the kernels' load or build, the inputs, the warm-up request)."""


def read(view):
    return view.setup_s
