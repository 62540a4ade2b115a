"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

``pv`` holds B1-B3 (counterpart of ``melonix_tpu/kernels/pallas_pv.py``),
``resample`` holds B4 and B11 (``melonix_tpu/kernels/pallas_resample.py``),
``frames`` holds B9 (``melonix_tpu/kernels/pallas_frames.py``),
``render`` holds B5-B6 (``melonix_tpu/kernels/pallas_render.py``),
``columns`` holds B7 (``melonix_tpu/kernels/pallas_columns.py``), ``pitch``
holds B8 (``melonix_tpu/kernels/pallas_pitch.py``), ``stft`` holds B12
(``melonix_tpu/kernels/pallas_stft.py``).  A
wrapper alone picks kernel or twin: it launches its kernel for a CUDA tensor
at a shape the kernel takes, runs its plain twin on the tensor's device
for a CPU tensor or another shape, and raises for any other device.  Every
launch goes through ``_build.launch``, which counts it in ``launches`` on
the wrapper.
"""
