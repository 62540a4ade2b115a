"""melonix_tpu_torch's sharded paths across 2 and 4 ranks of a gloo process
group on the CPU, against melonix_tpu on meshes of the same (data, seq)
shape over the virtual CPU devices.

The parent writes the JAX suite's ``chirp`` to a file, starts one process
per rank (this file, run as a script: its ``__main__`` block is the worker)
for each world size, and meanwhile runs the JAX references.  Each rank
joins the group over ``tcp://127.0.0.1:<port>``, builds a (1, n) and a
(2, n / 2) mesh, runs every case of ``torch_parallel_cases.port_results`` on
each, and writes the whole results it returns, with whether JAX or
melonix_tpu was imported, to a file.  The tests hold every rank's results
to rank 0's (each rank returns the whole gathered output) and rank 0's to
JAX's at the bars of ``tests/test_parallel.py``.  A world whose group
cannot form for want of a local port skips; anything else fails.

The worker imports numpy, torch, the port and ``torch_parallel_cases``
(which imports JAX only inside its JAX-side functions), never JAX.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
TIMEOUT = 300  # seconds per spawned rank


def _free_port():
    """A free local TCP port, or None when none can be bound."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    except OSError:
        return None


def _start(world, inputs, out_dir):
    port = _free_port()
    if port is None:
        return None
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(world), str(rank),
         str(port), inputs, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]


def _finish(procs):
    """(return codes, outputs) of the ranks, each waited for on its own
    timeout; a rank past it is killed, with the others."""
    codes, outs = [], []
    for p in procs:
        try:
            out = p.communicate(timeout=TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + f"\n[rank killed after {TIMEOUT} s]"
        codes.append(p.returncode)
        outs.append(out)
    return codes, outs


def _load(path):
    with np.load(path) as f:
        return {k.replace("__", "/"): f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, chirp):
    """{world: list of each rank's results}, {(data, seq): JAX results}."""
    import jax

    import torch_parallel_cases as cases

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    x, sr = chirp
    root = tmp_path_factory.mktemp("dist")
    inputs = str(root / "inputs.npz")
    np.savez(inputs, x=x, sr=np.int64(sr))
    started = {}
    for world in SHAPES:
        out_dir = root / f"world{world}"
        out_dir.mkdir()
        started[world] = (_start(world, inputs, str(out_dir)), out_dir)
    refs = {shape: cases.jax_results(*shape, x, sr)
            for world in SHAPES for shape in SHAPES[world]}
    results = {}
    for world, (procs, out_dir) in started.items():
        if procs is None:
            results[world] = None
            continue
        codes, outs = _finish(procs)
        if any(codes) and any("address already in use" in o.lower()
                              for o in outs):
            # the free port was taken between the probe and the bind: once
            # more on a fresh one
            procs = _start(world, inputs, str(out_dir))
            if procs is None:
                results[world] = None
                continue
            codes, outs = _finish(procs)
        if any(codes):
            text = "\n".join(f"--- rank {r} (exit {c}) ---\n{o[-4000:]}"
                             for r, (c, o) in enumerate(zip(codes, outs)))
            pytest.fail(f"world {world}: a rank failed\n{text}")
        results[world] = [_load(out_dir / f"rank{r}.npz")
                          for r in range(world)]
    return results, refs


def _ranks(runs, world):
    results, _refs = runs
    if results[world] is None:
        pytest.skip(f"gloo could not form a world of {world}: no local port")
    return results[world]


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_workers_import_no_jax(runs, world):
    for res in _ranks(runs, world):
        assert int(res["meta/jax_imported"]) == 0
        assert int(res["meta/melonix_tpu_imported"]) == 0
        assert int(res["meta/world"]) == world


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_every_rank_returns_the_whole_result(runs, world):
    ranks = _ranks(runs, world)
    for r, res in enumerate(ranks[1:], start=1):
        assert sorted(res) == sorted(ranks[0])
        for k, v in ranks[0].items():
            if not k.startswith("meta/"):
                assert np.array_equal(res[k], v), (r, k)


def _shape_cases():
    import torch_parallel_cases as cases

    return [(world, shape, name) for world in sorted(SHAPES)
            for shape in SHAPES[world] for name in cases.case_names(shape[0])]


@pytest.mark.parametrize(
    "world,shape,name", _shape_cases(),
    ids=[f"{s[0]}x{s[1]}-{n}" for _w, s, n in _shape_cases()])
def test_matches_jax_on_the_same_mesh(runs, world, shape, name):
    import torch_parallel_cases as cases

    got = _ranks(runs, world)[0][f"{shape[0]}x{shape[1]}:{name}"]
    cases.check(name, got, runs[1][shape][name])


@pytest.mark.parametrize("world,shape", [(w, s) for w in sorted(SHAPES)
                                         for s in SHAPES[w]])
def test_seq_pv_tail_not_attenuated(runs, world, shape):
    """test_parallel.py:518-540: the last size - hop samples of the
    seq-sharded render (the masked normaliser and the extra padding
    frames), both tracks."""
    import torch_parallel_cases as cases

    res = _ranks(runs, world)[0]
    for i in range(2):
        name = f"seq_pv/{i}"
        cases.tail_check(res[f"{shape[0]}x{shape[1]}:{name}"],
                         runs[1][shape][name])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_seq_pv_does_not_depend_on_the_shard_count(runs, shape):
    """The seq PV sums its phases in float64 and rounds once, so 4 ranks
    render what 2 seq shards render, up to float32 rounding at the OLA
    seams; the JAX package's float32 sums drift apart with the shard count
    on long tracks."""
    two = _ranks(runs, 2)[0]
    four = _ranks(runs, 4)[0]
    for i in range(2):
        got = four[f"{shape[0]}x{shape[1]}:seq_pv/{i}"].astype(np.float64)
        want = two[f"1x2:seq_pv/{i}"].astype(np.float64)
        assert got.shape == want.shape
        assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)) < 1e-6


def _worker(world, rank, port, inputs, out_dir):
    """One rank: join the group, run every case on each mesh shape of this
    world, write the results."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(HERE))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    import torch_parallel_cases as cases
    from melonix_tpu_torch.parallel import make_audio_mesh

    with np.load(inputs) as f:
        x, sr = f["x"], int(f["sr"])
    res = {}
    for data, seq in SHAPES[world]:
        mesh = make_audio_mesh(world, data=data, device="cpu")
        assert mesh.shape == {"data": data, "seq": seq}
        for k, v in cases.port_results(mesh, x, sr).items():
            res[f"{data}x{seq}:{k}".replace("/", "__")] = v
    res["meta__jax_imported"] = np.int64("jax" in sys.modules)
    res["meta__melonix_tpu_imported"] = np.int64("melonix_tpu" in sys.modules)
    res["meta__world"] = np.int64(dist.get_world_size())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _w, _r, _p, _in, _out = sys.argv[1:6]
    _worker(int(_w), int(_r), int(_p), _in, _out)
