"""Operation and byte counts of the program's hand-written kernels, one file per kernel.

A file ``<name>.py`` counts the launches of the kernel the profiler names
``<name>`` (its template arguments, where they select a variant, reach the
file as ``launch["template"]``).  Each gives ``count(launch, cfg, frames)``
-> (bytes, integer operations) of one launch, as the algorithm needs them,
or None where it cannot tell: ``launch`` holds "template" (a list of
strings), "nth" (the launch's index among this kernel's launches in its
segment) and "span" (the benchmark span it ran in: "encode", "decode",
...); ``cfg`` is the configuration's ``CodecConfig`` fields and ``frames``
the segment's frames, each {"type": 0 intra or 1 inter, "nsplit": split
blocks}.  Bytes count each input read once and each output written once;
operations count what the algorithm needs (abs-diff-accumulates of each
valid candidate pixel, the transforms' multiply-adds).
"""
