"""StreamOptima on PyTorch + CUDA (NVIDIA Hopper).

A port of the ``streamoptima_tpu`` codec's main path: I/P frames with
whole-pel full-search motion estimation, mode-0 intra prediction, the exact
fixed-point integer DCT, power-of-two quantization and the text bitstream.
Plain code is PyTorch; the two kernels of the path (the full search and the
decode prediction fetch) are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``_build.py``).  Tensors on the
CPU take each kernel's plain PyTorch version instead, which is what the CPU
tests hold against the JAX package.

The JAX package is the reference and is reused by import only where its
modules are JAX-free (config, bitstream, native serializer, video I/O,
synthetic clips, numpy constant tables); this package never imports JAX.
``CodecConfig`` and the seeded ``synthetic_clip`` are re-exported here, so a
caller of the port needs no other package.
"""
from streamoptima_tpu.config import CodecConfig
from streamoptima_tpu.utils import synthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.engine import TorchCodec

__all__ = ["CodecConfig", "TorchCodec", "VideoCodec", "synthetic_clip"]
