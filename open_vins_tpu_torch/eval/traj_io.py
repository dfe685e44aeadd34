"""Trajectory file IO: TUM / EuRoC formats, recording, format conversion.

Pure numpy, offline; a copy of `open_vins_tpu/eval/traj_io.py`.

Capability parity with ov_eval utils (Loader.h:51-97, Recorder.h:47-120) and
the format_converter binary (EuRoC groundtruth csv -> TUM text), plus the
reference's DatasetReader groundtruth loading (dataset_reader.h:62-175).

TUM format rows: ``t x y z qx qy qz qw`` (Hamilton, body-to-global) with
optional covariance columns appended (the reference's "rpng" extended format
writes pose + 21 upper-triangular covariance entries).
"""

from __future__ import annotations

import numpy as np


def load_tum(path):
    """Load a TUM trajectory file -> (t [N], p [N,3], q_xyzw [N,4])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def save_tum(path, t, p, q_xyzw):
    """Write a TUM trajectory file (Recorder parity)."""
    with open(path, "w") as f:
        f.write("# timestamp(s) tx ty tz qx qy qz qw\n")
        for i in range(len(t)):
            f.write(
                f"{t[i]:.9f} {p[i][0]:.6f} {p[i][1]:.6f} {p[i][2]:.6f} "
                f"{q_xyzw[i][0]:.6f} {q_xyzw[i][1]:.6f} {q_xyzw[i][2]:.6f} "
                f"{q_xyzw[i][3]:.6f}\n"
            )


def load_euroc_gt(path):
    """Load EuRoC state_groundtruth_estimate0/data.csv ->
    (t [N] seconds, p [N,3], q_xyzw [N,4] Hamilton body-to-global,
     v [N,3], bw [N,3], ba [N,3]).

    Mirrors DatasetReader::load_gt_file / format_converter: EuRoC rows are
    ``t_ns, px, py, pz, qw, qx, qy, qz, vx..., bw..., ba...``.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            rows.append([float(x) for x in parts[:17]])
    arr = np.asarray(rows, dtype=np.float64)
    t = arr[:, 0] * 1e-9
    p = arr[:, 1:4]
    q_wxyz = arr[:, 4:8]
    q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
    v = arr[:, 8:11]
    bw = arr[:, 11:14]
    ba = arr[:, 14:17]
    return t, p, q_xyzw, v, bw, ba


def quat_xyzw_to_rot(q):
    """Hamilton [x,y,z,w] -> R (body-to-global), batched."""
    q = np.asarray(q, dtype=np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rot_to_quat_xyzw(R):
    """R (body-to-global) -> Hamilton [x,y,z,w], batched (Shepperd)."""
    R = np.asarray(R, dtype=np.float64)
    out = np.empty(R.shape[:-2] + (4,))
    flat = R.reshape(-1, 3, 3)
    of = out.reshape(-1, 4)
    for i, M in enumerate(flat):
        tr = np.trace(M)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            of[i] = [(M[2, 1] - M[1, 2]) / s, (M[0, 2] - M[2, 0]) / s,
                     (M[1, 0] - M[0, 1]) / s, 0.25 * s]
        elif M[0, 0] > M[1, 1] and M[0, 0] > M[2, 2]:
            s = np.sqrt(1.0 + M[0, 0] - M[1, 1] - M[2, 2]) * 2
            of[i] = [0.25 * s, (M[0, 1] + M[1, 0]) / s,
                     (M[0, 2] + M[2, 0]) / s, (M[2, 1] - M[1, 2]) / s]
        elif M[1, 1] > M[2, 2]:
            s = np.sqrt(1.0 + M[1, 1] - M[0, 0] - M[2, 2]) * 2
            of[i] = [(M[0, 1] + M[1, 0]) / s, 0.25 * s,
                     (M[1, 2] + M[2, 1]) / s, (M[0, 2] - M[2, 0]) / s]
        else:
            s = np.sqrt(1.0 + M[2, 2] - M[0, 0] - M[1, 1]) * 2
            of[i] = [(M[0, 2] + M[2, 0]) / s, (M[1, 2] + M[2, 1]) / s,
                     0.25 * s, (M[1, 0] - M[0, 1]) / s]
    return out


def euroc_to_tum(csv_path, out_path):
    """format_converter parity: EuRoC gt csv -> TUM text file."""
    t, p, q, *_ = load_euroc_gt(csv_path)
    save_tum(out_path, t, p, q)
