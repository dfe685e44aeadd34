"""The parallel layer on torch.distributed: process groups, the row-sharded
EKF update, the distributed Schur BA, the window refinement and the
multi-rank dry run."""
