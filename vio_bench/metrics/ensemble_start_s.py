"""Seconds of `runner.ensemble_start` in set-up (every stream's
groundtruth start and empty track table, stacked), by the harness's clock
between two synchronizes."""

UNIT = "s"
LAYER = "runner (models/runner.ensemble_step, ensemble_start)"
MOVES = "setup_s"


def read(run):
    return run.ensemble_start_s
