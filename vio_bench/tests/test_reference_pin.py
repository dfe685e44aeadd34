"""The reference's MSCKF-only path, pinned: its pass from the start over the
tiny MSCKF cell's streams (two streams of `sim_msckf` on a short stream,
float64, CPU) hashes, frame by frame, to what the reference gave before it
followed SLAM landmarks.  Every field of the state (the covariance with
it), of the step's diag and the gate margin of every frame enters the
hash, bit for bit.  One thread: the CPU's BLAS sums in another order with
more threads.

    python -m pytest --noconftest vio_bench/tests/test_reference_pin.py -q
"""

import hashlib
import json

import pytest
import torch

from vio_bench import check, gen
from vio_bench.tests.tiny import ROOT

SEED = 2 ** 31 + 3
# sha256 of stream 0's pass, of stream 1's: 16 frames of a 0.85 s stream
# (marginalization from frame 11 on, full-window updates), as in
# msckf.mc's passes
DURATION, FRAMES = 0.85, 16
PINNED = (
    "4a7a18b07809779e7b829976ef34186facc7244a96dae3dcfa43c9ca01f163df",
    "5c71e1314fa71c45745482419d7346691b5426278588e46240e07eaf94a21082")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pass_digest(config, streams, b, frames):
    h = hashlib.sha256()
    for st, diag, near, _ in check.reference_pass(config, streams, b,
                                                  frames):
        for rec in (st, diag):
            for k, v in rec.items():
                h.update(k.encode())
                h.update(v.contiguous().numpy().tobytes())
        h.update(float(near).hex().encode())
    return h.hexdigest()


def test_msckf_pass_is_pinned(one_thread):
    config = json.loads(
        (ROOT / "vio_bench/configs/sim_msckf.json").read_text())
    config["sim"]["duration"] = DURATION
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), 2, SEED,
                               "cpu", chunk=2)
    got = tuple(_pass_digest(config, streams, b, FRAMES) for b in range(2))
    assert got == PINNED
