"""mp3rgain_tpu_torch — the ReplayGain analysis path on PyTorch and CUDA.

A port of mp3rgain_tpu's MP3 raw-bits analysis path (host light walk →
device Huffman decode → requantize + stereo → hybrid and polyphase GEMMs →
equal-loudness IIR → loudness histogram) to PyTorch, with the JAX
package's two Pallas kernels rewritten by hand for NVIDIA Hopper: the
Huffman decode in CUDA C++ (csrc/entropy_decode.cu) and the fused
requantize + stereo pass in Triton (decode/hybrid_kernel.py). Shared host
code (the native C++ core and the MP3 front-end) comes from mp3rgain_tpu;
this package never imports jax.

Entry points: analysis.analyze_track_internal / analyze_album /
find_peak_amplitude and parallel.runner.Runner.analyze_unpacked_light,
each with an explicit device.
"""
