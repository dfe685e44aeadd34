"""The batched generator against the port's simulator (CPU):

    python -m pytest --noconftest vio_bench/tests -q
"""

import torch

from vio_bench import gen

SIM = gen.Sim.from_dict(dict(num_pts=200, map_size=2048, duration=1.5,
                             start_offset=3.0))


def _draws(B, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return gen.draw(SIM, B, g, "cpu")


def test_stream_equals_port_staging():
    """Stream b of one batched call equals `runner.stage_run` of the
    port's simulator built from stream b's draws."""
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.sim import simulator

    d = _draws(3, 11)
    streams = gen.Generator(SIM, torch.device("cpu")).stage(d)
    params = simulator.SimParams(**{k: getattr(SIM, k) for k in (
        "num_pts", "map_size", "duration", "start_offset")})
    for b in range(3):
        draws = simulator.SimDraws(**{k: getattr(d, k)[b]
                                      for k in gen.Draws.__dataclass_fields__})
        sim = simulator.build(params, draws=draws, device="cpu")
        run, cal = runner.stage_run(sim, params), runner.sim_calib(sim)
        f = run.frames
        port = dict(win_t=f.win.t, win_w=f.win.w, win_a=f.win.a,
                    t_new=f.t_new, ids=f.ids, uv=f.uv, uvn=f.uvn,
                    mask=f.mask, gt_q=run.gt_q, gt_p=run.gt_p, gt_v=run.gt_v,
                    bias_g0=cal.bias_g0, bias_a0=cal.bias_a0,
                    cam_R_ItoC=cal.cam_R_ItoC, cam_p_IinC=cal.cam_p_IinC,
                    cam_intr=cal.cam_intr)
        for k, v in port.items():
            assert torch.equal(getattr(streams, k)[b], v), (b, k)


def test_one_seed_one_input():
    """Two calls with one seed give identical streams, chunked or not;
    another seed gives other draws."""
    a = gen.make_streams(SIM, 3, 2 ** 31 + 5, "cpu", chunk=2)
    b = gen.make_streams(SIM, 3, 2 ** 31 + 5, "cpu", chunk=2)
    c = gen.make_streams(SIM, 3, 2 ** 31 + 6, "cpu", chunk=2)
    for k in gen.Streams.__dataclass_fields__:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert not torch.equal(a.uv, c.uv)
    assert a.n_streams == 3 and a.n_frames == SIM.n_frames - 1
