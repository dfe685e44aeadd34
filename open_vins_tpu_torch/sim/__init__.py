"""The simulator: SE(3) B-spline trajectories, trajectory files and the
seeded visual-inertial sensor stream."""
