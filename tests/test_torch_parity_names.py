"""Every public function and class of melonix_tpu has its counterpart in
melonix_tpu_torch.

Reads both packages' sources with ``ast`` (nothing is imported, so no JAX
either): each public top-level ``def`` or ``class`` of ``melonix_tpu/``
must be defined at the top level of some module of ``melonix_tpu_torch/``
under the same name, with ``_jax`` replaced by ``_torch``, or under the
new name ``RENAMED`` gives it.  The
exceptions are the 12 functions that reach ``pl.pallas_call`` (each has
its CUDA kernel, held against its plain twin by ``chip_smoke.py`` and
listed in PERF.md's kernel table) and the TPU-only names of ROADMAP.md's
"Not to port" list, written out below.
"""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]

# Each function whose body calls pl.pallas_call (PERF.md's B1-B12).
PALLAS_KERNELS = {
    "stft_mag_fourstep", "analysis", "synth_ola_phase", "synth_ola",
    "resample_pv_pallas", "resample_lerp_pallas", "_render_steps",
    "compact_pallas", "spectrogram_columns_fused", "pitch_ac_pallas",
    "extract_frames_pallas", "stft_mag_pallas",
}

# ROADMAP.md, "Not to port": what exists only because of the TPU.
NOT_TO_PORT = {
    # runtime/compile_cache.py: the persistent XLA cache (its warm-up half
    # is runtime/warmup.py)
    "enable",
    # kernels/lane_gather.py, bf16x3.py, fftmm.py, packfft.py: Mosaic and
    # MXU idioms
    "lerp_rows", "place_at", "realign", "shift_one",
    "dot", "split", "split_np",
    "fft_matmul", "fft_matmul_real",
    "irfft_packed",
    # the granular render's TPU limits and SMEM chunking
    "plan_supported", "plan_chunks",
    # the Pallas modules' TPU launch plumbing: block maps and operand
    # marshalling of B5 + B6, B4's (rows, 128) source view, the bf16x3
    # four-step constants and scrambled lane order of B1-B3, and the shape
    # gate of the scrambled-order kernels
    "args_for", "granular_render_pallas", "render_pallas_full",
    "pad_src",
    "fourstep_consts", "scrambled_bins", "scrambled_omega",
    "stft_supported", "pv_fused_shapes_ok",
}

# The JAX package's names whose counterpart in the port has another name:
# utils.tracing's ``annotate`` is the port's ``span``, which also records.
RENAMED = {"annotate": "span"}


def _defs(package: str) -> dict[str, list[str]]:
    """name -> modules defining it at top level, over every ``def`` and
    ``class`` of the package (private names included)."""
    out: dict[str, list[str]] = {}
    for path in sorted((REPO / package).rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.setdefault(node.name, []).append(
                    str(path.relative_to(REPO)))
    return out


def _pallas_callers() -> set[str]:
    names = set()
    for path in sorted((REPO / "melonix_tpu").rglob("*.py")):
        for node in ast.parse(path.read_text(), str(path)).body:
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                    for n in ast.walk(node)):
                names.add(node.name)
    return names


def test_every_public_name_has_a_counterpart():
    jax_defs, port_defs = _defs("melonix_tpu"), _defs("melonix_tpu_torch")
    missing = sorted(
        f"{name} ({', '.join(where)})"
        for name, where in jax_defs.items()
        if not name.startswith("_")
        and name not in PALLAS_KERNELS | NOT_TO_PORT
        and RENAMED.get(name, name) not in port_defs
        and name.replace("_jax", "_torch") not in port_defs)
    assert not missing, "no counterpart in melonix_tpu_torch: " + "; ".join(
        missing)


def test_the_exceptions_are_what_they_say():
    """The kernel list is exactly the functions that reach pl.pallas_call,
    every exception still names something of the JAX package, and every
    renamed counterpart is in the port under its new name alone."""
    assert _pallas_callers() == PALLAS_KERNELS
    jax_defs, port_defs = _defs("melonix_tpu"), _defs("melonix_tpu_torch")
    assert not sorted(n for n in NOT_TO_PORT if n not in jax_defs)
    for old, new in RENAMED.items():
        assert old in jax_defs and new in port_defs and old not in port_defs

