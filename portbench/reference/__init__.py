"""The benchmark's plain reference of the codec: plain PyTorch and numpy.

``ReferenceEncoder(cfg, device).encode(frames)`` gives a segment's SOTPB1
container bytes and its reconstructions, which the encoder's decode must
reproduce.  The modules beside ``encoder.py`` and ``container.py`` are
frozen copies of the plain code that the port's CPU tests hold bit-exact to
the JAX package (``core/`` and the kernels' plain versions), kept here so
that a later change to the program cannot move the yardstick.  Nothing here
imports the program, JAX or the JAX package.
"""
from .encoder import ReferenceEncoder

__all__ = ["ReferenceEncoder"]
