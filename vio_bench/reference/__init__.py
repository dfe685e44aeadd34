"""The benchmark's plain reference of one filter frame: a frozen copy of
the port's step (`manager.step_frame` and what it calls) at the commit that
added the benchmark, cut to the configurations' paths, one stream at a
time, without `torch.func.vmap`, the hand-written kernels or the
measurement compressions.  The harness runs it in float64 on the CPU from
the program's own state before a sampled frame (`vio_bench/check.py`).
It imports nothing of the program: a later change to the program leaves it
as it is.
"""
