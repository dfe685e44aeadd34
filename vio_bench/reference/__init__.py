"""The benchmark's plain reference of one filter frame: a frozen copy of
the port's step (`manager.step_frame` and what it calls), cut to the
configurations' paths, one stream at a time, without `torch.func.vmap`,
the hand-written kernels or the measurement compressions.  The harness
runs it in float64 on the CPU from the program's own state before a
sampled frame (`vio_bench/check.py`).  It imports nothing of the program:
a later change to the program leaves it as it is.

It follows two deployments of OpenVINS's
`config/euroc_mav/estimator_config.yaml`, both under rk4 and with one
camera, no online calibration, ZUPT or aruco (`manager.check_config`
refuses any other option by name):

  * pure MSCKF (`max_slam` 0), frozen when the benchmark was added;
  * SLAM landmarks in the state (`max_slam` > 0), stored as that file
    stores them (ANCHORED_MSCKF_INVERSE_DEPTH, with the anchor change at
    marginalization) or as global points (GLOBAL_3D), with promotion,
    delayed init, the joint "qr" update and eviction
    (`updater_slam`, `landmark_rep`), frozen one stack later.

Where it departs: from the port, the stacks are applied uncompressed (the
same update in exact arithmetic); from OpenVINS, as the port does, the
MSCKF, landmark and delayed-init rows go into one joint update at one
linearization where OpenVINS updates by them in turn (VioManager.cpp:
520-544), new landmarks are inserted jointly, and the sizes are static
(`manager`).
"""
