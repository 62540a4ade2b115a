#!/usr/bin/env python3
"""The editor's first frame and first audio on one NVIDIA GPU, from a cold
kernel build.

    python3 ui_first_frame.py

Starts an ``EditorServer`` of ``melonix_tpu_torch`` on the card over a 30 s
excerpt of ``chip_smoke.py``'s song and times, from the start of the
process: the file's open (the native host runtime builds here on a fresh
checkout), the first ``/frame.png`` (its lane black until the tiles
land), the tile worker's first drain settled (the CUDA kernels build in
that thread on a fresh checkout, under ``kernels/_build.py``'s lock), the
first frame with the lane drawn, and the first 1024 samples of the live
PV stream.  It says whether ``build/kernels`` and ``build/native`` held a
library at the start (a warm run measures no build).  Prints the card's
name and power limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def main() -> int:
    import http.client

    import torch

    if not torch.cuda.is_available():
        print("ui_first_frame: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from melonix_tpu_torch.io.wav import write_wav
    from melonix_tpu_torch.kernels import _build
    from melonix_tpu_torch.runtime import native
    from melonix_tpu_torch.ui.state import MENU_BAR_PX
    from melonix_tpu_torch.ui.web import EditorServer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    warm = {"kernels": (_build.BUILD_DIR / _build.LIB_NAME).exists(),
            "native": (native.BUILD_DIR / native.LIB_NAME).exists()}
    marks = {"imports": time.perf_counter() - T0}
    x = cs.make_song(cs.SR, 30.0)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MELONIX_AUTOSAVE_DIR"] = os.path.join(tmp, "autosave")
        path = os.path.join(tmp, "excerpt.wav")
        write_wav(path, x, cs.SR, dtype="float32")
        srv = EditorServer(autosave_interval=0)
        srv.state.open_file(path)
        marks["open"] = time.perf_counter() - T0
        cl = cs.UiClient(srv.start(), timeout=300)
        try:
            body, _ = cl.get(cs.UI_FRAME.replace("fmt=jpg", "fmt=png"))
            marks["first frame"] = time.perf_counter() - T0
            cs.ui_settle(cl, limit_s=300.0)
            marks["tiles settled"] = time.perf_counter() - T0
            bars = cs.load_oracle(root, "scene_bars")
            body, _ = cl.get(cs.UI_FRAME.replace("fmt=jpg", "fmt=png"))
            lane = bars.decode_png(body)[
                MENU_BAR_PX: MENU_BAR_PX + int(srv.state.viewport.lane_height)]
            cs.check(lane.sum() > 0, "the lane is black after the drain")
            marks["lane drawn"] = time.perf_counter() - T0
            cl.post("/control", {"action": "engine", "value": "pv"})
            s = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
            try:
                s.request("GET", "/audio/stream?from=0&pace=0")
                r = s.getresponse()
                cs.check(len(r.read(44 + 2048)) == 44 + 2048, "first audio")
                marks["first PV audio"] = time.perf_counter() - T0
            finally:
                s.close()
        finally:
            cl.close()
            srv.stop()
    print(card)
    print(f"editor first frame on {torch.cuda.get_device_name(0)}, libraries "
          f"present at start: {warm}; seconds from process start: "
          + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()) + f" | {card}")
    print(json.dumps({"warm": warm, "seconds": marks, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
