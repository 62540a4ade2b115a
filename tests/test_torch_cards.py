"""One process per card: the port's rank-to-card mapping, its device
checks and its launcher, on the CPU.

* ``resolve_device``, ``rank_device``, ``_build.on_card`` /
  ``require`` and the NCCL operand check of ``_gather``, with the card
  count, the current card and the group's backend patched; a gloo group
  formed through ``join_group``.
* ``launch(["batch", ..., "--device", "cpu"], n)`` at n = 2 and 4 over
  gloo: rank 0's files against the JAX CLI's ``batch`` on its 8 virtual
  CPU devices at ``test_cli_batch_matches_jax``'s bars (granular within
  one int16 step, PV at SNR < -60 dB), for ``granular``, ``pv`` and ``pv
  --autotune``; only rank 0 writes, and no rank imports JAX or
  ``melonix_tpu`` (the ranks run ``tests/launch_target.py``, the CLI with
  its writers counted).
* ``render --stereo --device cpu`` through ``python -m melonix_tpu_torch``
  at world 2 against the world-1 render (granular within 2e-6 with equal
  zeros, PV equal: phase 20's bars).
* A rank that fails makes ``launch`` return non-zero at once, and ranks
  past the timeout make it return 124; no rank is left running either way.
* The parent builds the kernels once before any rank starts, and never for
  ``--device cpu``; the CLI's ``batch`` started alone launches no ranks.
* Every wrapper of ``kernels/`` launches through ``_build.launch``, which
  makes the operands' card current with ``torch.cuda.device``.
"""

import ast
import concurrent.futures
import importlib
import socket
import json
import os
import subprocess
import time
import types

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from melonix_tpu.cli import main as j_cli

import melonix_tpu_torch as mt
from melonix_tpu_torch.cli import main as t_cli
from melonix_tpu_torch.engine.spectral import resolve_device
from melonix_tpu_torch.io.wav import read_wav, write_wav
from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.parallel import sharded as tsh
from melonix_tpu_torch.runtime import native

# the module, which the package's ``launch`` function shadows
tlaunch = importlib.import_module("melonix_tpu_torch.parallel.launch")

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = (2, 4)
EXTRAS = {"granular": ["--engine", "granular"], "pv": ["--engine", "pv"],
          "pv-autotune": ["--engine", "pv", "--autotune"]}
TIMEOUT = 240  # seconds a launch may take


def _snr_db(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return 10 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))


@pytest.fixture
def cards(monkeypatch):
    """A machine with 4 cards, cuda:0 current: ``set_device`` moves the
    current card and is recorded."""
    state = {"current": 0, "set": []}

    def set_device(i):
        state["set"].append(int(i))
        state["current"] = int(i)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    for k in tlaunch.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return state


def _launcher_env(monkeypatch, rank, world=4):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")


# ----------------------------------------------------------------------
# Devices
# ----------------------------------------------------------------------


def test_resolve_device_indexes_a_bare_cuda(cards):
    cards["current"] = 3
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda:3")
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")
    assert cards["set"] == []  # resolving never moves the current card


def test_resolve_device_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_rank_device_maps_local_rank_to_its_card(cards, monkeypatch, rank):
    _launcher_env(monkeypatch, rank)
    assert tlaunch.rank_device("cuda") == torch.device("cuda", rank)
    assert cards["set"] == [rank] and cards["current"] == rank


def test_rank_device_refuses_a_rank_without_a_card(cards, monkeypatch):
    _launcher_env(monkeypatch, 4, world=5)
    with pytest.raises(tlaunch.RankDeviceError,
                       match=r"rank 4 .*cuda:4.* 4 card\(s\)"):
        tlaunch.rank_device("cuda")
    assert cards["set"] == []
    with pytest.raises(tlaunch.RankDeviceError):
        tlaunch.rank_device("cuda:7")


def test_rank_device_leaves_the_cpu_and_explicit_cards(cards, monkeypatch):
    assert tlaunch.rank_device("cpu") == torch.device("cpu")
    cards["current"] = 2
    assert tlaunch.rank_device("cuda") == torch.device("cuda:2")  # alone
    _launcher_env(monkeypatch, 1)
    assert tlaunch.rank_device("cpu") == torch.device("cpu")
    assert tlaunch.rank_device("cuda:3") == torch.device("cuda:3")
    assert cards["set"] == [2, 3]


def _fake_tensor(device):
    return types.SimpleNamespace(device=torch.device(device),
                                 dtype=torch.float32, shape=(4,),
                                 is_contiguous=lambda: True)


def test_cuda_device_takes_a_tensor_on_any_card(cards):
    """A tensor on another card than the current one is on a card as it
    is (its wrapper launches on its card), and checking it never moves the
    current card; a CPU tensor is not on one (its wrapper runs the twin),
    and any other device is refused."""
    assert _build.on_card(_fake_tensor("cuda:1")) is True
    assert cards["current"] == 0 and cards["set"] == []
    assert _build.on_card(_fake_tensor("cpu")) is False
    with pytest.raises(ValueError, match="plain twin"):
        _build.on_card(_fake_tensor("meta"))


def _is_cuda_device(node) -> bool:
    return ast.unparse(node).startswith("torch.cuda.device(")


def _functions(tree):
    return [fn for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _names_entry(node) -> bool:
    """Whether ``node`` names a C entry point: ``lib.mlx_*`` or the
    string ``"mlx_*"``."""
    return ((isinstance(node, ast.Attribute) and node.attr.startswith("mlx_"))
            or (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("mlx_")))


@pytest.mark.parametrize("module", sorted(
    m for m in os.listdir(os.path.dirname(_build.__file__))
    if m.endswith(".py") and m != "_build.py"))
def test_every_launch_runs_on_its_operands_card(module):
    """Every function of ``kernels/`` that names a C entry point launches
    it through ``_build.launch``, and no module of ``kernels/`` but
    ``_build.py`` switches cards, calls an entry itself or counts a
    launch; ``_build.launch`` makes a card current with
    ``torch.cuda.device`` around the call: the C side launches on the
    calling thread's current card, so a tensor on another card still
    launches on its own."""
    path = os.path.join(os.path.dirname(_build.__file__), module)
    with open(path) as f:
        text = f.read()
    for fn in _functions(ast.parse(text)):
        entries = [n.lineno for n in ast.walk(fn) if _names_entry(n)]
        launches = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                    and ast.unparse(c.func) == "_build.launch"]
        assert launches or not entries, (
            f"{module}:{entries[0] if entries else fn.lineno}: {fn.name} "
            "names an entry without _build.launch")
    for own in ("torch.cuda.device(", "lib.mlx_", "launches += 1",
                'span("kernel.'):
        assert own not in text, f"{module}: {own}"
    with open(_build.__file__) as f:
        (launch,) = [fn for fn in _functions(ast.parse(f.read()))
                     if fn.name == "launch"]
    assert any(isinstance(w, ast.With) and any(
        _is_cuda_device(i.context_expr) for i in w.items)
        for w in ast.walk(launch))


def test_require_takes_a_bare_cuda_as_the_current_card(cards):
    cards["current"] = 2
    _build.require(_fake_tensor("cuda:2"), "t", torch.float32, (4,), "cuda")
    with pytest.raises(ValueError, match="expected cuda:2"):
        _build.require(_fake_tensor("cuda:0"), "t", torch.float32, (4,),
                       torch.device("cuda"))


def test_nccl_gather_refuses_a_host_operand(monkeypatch):
    monkeypatch.setattr(tsh.dist, "get_backend", lambda group: "nccl")
    for dtype in (torch.int32, torch.float64, torch.bool):
        with pytest.raises(ValueError, match="NCCL"):
            tsh._gather(torch.zeros(3, dtype=dtype), object(), 2)


def test_join_group_forms_a_gloo_group_on_the_cpu(monkeypatch):
    import torch.distributed as dist

    assert not dist.is_initialized()
    _launcher_env(monkeypatch, 0, world=1)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        monkeypatch.setenv("MASTER_PORT", str(sock.getsockname()[1]))
    try:
        assert tlaunch.join_group("cpu") == torch.device("cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert tlaunch.join_group("cpu") == torch.device("cpu")  # joined
        mesh = mt.make_audio_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "seq": 1}
    finally:
        tlaunch.leave_group()
    assert not dist.is_initialized()


# ----------------------------------------------------------------------
# The launcher: build once, every card
# ----------------------------------------------------------------------


class _Proc:
    returncode = 0

    def wait(self, timeout=None):
        return self.returncode


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_launch_builds_once_in_the_parent(monkeypatch, device):
    """The kernels are built once, in the parent, before the ranks start,
    and only for a card; the native library once for either device; then
    one ``torch.distributed.run`` starts the ranks."""
    log = []
    monkeypatch.setattr(_build, "build",
                        lambda: log.append(("kernels", os.getpid())))
    monkeypatch.setattr(native, "build_library",
                        lambda: log.append(("native", os.getpid())))
    monkeypatch.setattr(tlaunch, "subprocess", types.SimpleNamespace(
        Popen=lambda cmd, env: log.append(("ranks", cmd[2:6])) or _Proc(),
        TimeoutExpired=subprocess.TimeoutExpired))
    argv = ["batch", "x*.wav", "-o", "out"]
    if device == "cpu":
        argv += ["--device", "cpu"]
    assert tlaunch.launch(argv, 3) == 0
    built = [("native", os.getpid())]
    if device == "cuda":
        built.append(("kernels", os.getpid()))
    assert log == built + [("ranks", ["torch.distributed.run", "--standalone",
                                      "--nproc-per-node=3",
                                      "--max-restarts=0"])]


def test_cli_batch_stays_in_one_process(cards, monkeypatch, tmp_path):
    """Started alone, ``batch --device cuda`` renders in its own process
    however many cards there are: it launches no ranks."""
    calls = []
    monkeypatch.setattr(tlaunch, "launch",
                        lambda *a, **k: calls.append(a) or 0)
    joined = []
    monkeypatch.setattr(tlaunch, "join_group",
                        lambda device: joined.append(device) or device)
    out = tmp_path / "out"
    assert t_cli(["batch", str(tmp_path / "x*.wav"), "-o", str(out)]) == 2
    assert calls == [] and joined == []  # no files: nothing rendered


def _pid_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("mode,code", [("fail", 3), ("sleep", 124)])
def test_launch_ends_every_rank(tmp_path, mode, code):
    """``fail``: rank 1 exits ``code`` while rank 0 sleeps, and ``launch``
    returns non-zero at once; ``sleep``: both ranks outlive the timeout and
    ``launch`` returns ``code``.  No rank is left running either way."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.monotonic()
    rc = tlaunch.launch([mode, str(tmp_path), str(code), "--device", "cpu"],
                        2, module="launch_target", env=env,
                        timeout=None if mode == "fail" else 5)
    assert (rc not in (0, 124) if mode == "fail" else rc == code)
    assert time.monotonic() - t0 < 60
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert all(_pid_gone(p) for p in pids)


# ----------------------------------------------------------------------
# The launched CLI against the JAX package's
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory, chirp):
    """The JAX CLI's files for each engine and the launched port's at
    world 2 and 4, with each launch's exit code and its ranks' audits."""
    root = tmp_path_factory.mktemp("cards")
    x, sr = chirp
    for i, t in enumerate(cases._batch_tracks(x)):
        write_wav(str(root / f"take{i}.wav"), t, sr, dtype="float32")
    markers = root / "m.json"
    markers.write_text(mt.markers_to_json(
        [mt.Marker(*m) for m in cases.BATCH_SETS[2]]))
    base = [str(root / "take*.wav"), "--markers", str(markers)]

    def run(world, name):
        out = root / f"t{world}-{name}"
        audit = root / f"audit{world}-{name}"
        audit.mkdir()
        env = dict(os.environ, PYTHONPATH=HERE, LAUNCH_AUDIT_DIR=str(audit))
        rc = tlaunch.launch(
            ["cli", "batch", *base, *EXTRAS[name], "-o", str(out),
             "--device", "cpu"], world, module="launch_target", env=env,
            timeout=TIMEOUT)
        ranks = [json.loads((audit / f"rank{r}.json").read_text())
                 if (audit / f"rank{r}.json").exists() else None
                 for r in range(world)]
        return rc, out, ranks

    # the launches wait on their ranks in threads while JAX renders here
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {(w, n): pool.submit(run, w, n)
                   for w in WORLDS for n in EXTRAS}
        for name, extra in EXTRAS.items():
            assert j_cli(["batch", *base, *extra, "-o",
                          str(root / f"j-{name}")]) == 0
        runs = {k: f.result() for k, f in futures.items()}
    return root, runs


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_launched_batch_matches_jax(batch_runs, world, name):
    root, runs = batch_runs
    rc, out, _ranks = runs[world, name]
    assert rc == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(root / f"j-{name}"))
    assert names == [f"take{i}.wav" for i in range(3)]
    for n in names:
        got, rate = read_wav(str(out / n))
        want, rate_j = read_wav(str(root / f"j-{name}" / n))
        assert rate == rate_j and got.shape == want.shape
        if name == "granular":  # within one int16 step
            assert np.abs(got - want).max() <= 1.01 / 32767
        else:
            assert _snr_db(got, want) < -60.0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_only_rank0_writes_and_no_rank_imports_jax(batch_runs, world, name):
    _root, runs = batch_runs
    _rc, _out, ranks = runs[world, name]
    assert all(r is not None for r in ranks)
    assert [r["writes"] for r in ranks] == [3] + [0] * (world - 1)
    for r in ranks:
        assert r["rc"] == 0 and r["world"] == world
        assert not r["jax"] and not r["melonix_tpu"]


@pytest.mark.parametrize("engine", ["granular", "pv"])
def test_launched_render_equals_the_world1_render(tmp_path, chirp, engine):
    x, sr = chirp
    src = str(tmp_path / "st.wav")
    write_wav(src, cases._stereo(x), sr, dtype="float32")
    markers = tmp_path / "m.json"
    markers.write_text(mt.markers_to_json(
        [mt.Marker(*m) for m in cases.SESSION_MARKERS]))
    args = ["render", src, "--markers", str(markers), "--stereo", "--engine",
            engine, "--dtype", "float32", "--device", "cpu"]
    one, two = str(tmp_path / "one.wav"), str(tmp_path / "two.wav")
    assert t_cli([*args, "-o", one]) == 0
    assert tlaunch.launch([*args, "-o", two], 2, timeout=TIMEOUT) == 0
    want, rate = read_wav(one)
    got, rate_2 = read_wav(two)
    assert rate == rate_2 and got.shape == want.shape and want.ndim == 2
    if engine == "granular":
        assert np.abs(got - want).max() <= 2e-6
        assert np.array_equal(got == 0.0, want == 0.0)
    else:
        assert np.array_equal(got, want)
