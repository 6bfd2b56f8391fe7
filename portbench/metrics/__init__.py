"""Metric readers, one file per metric: ``read(run)`` -> the metric's value, or None where the run has nothing to read.

``run`` holds "kind" (the traffic driver's: "encode" or "decode"), "cfg"
(the configuration's fields), "setup_s", "window" (the measured window:
"window_s", "latencies_s", "frames", "counters"), "spans" (the traced
run's seconds in each benchmark span over the window), "profile" (the
traced slice: "window_s", "busy_s", "ops", "frames", "segments"), "peaks"
and "kernels" (the count files, by kernel name).
"""
