"""ATDN vSLAM in PyTorch, for NVIDIA Hopper GPUs.

A port of ``atdn_vslam_tpu`` (the JAX package, which stays the
reference): the same models, layouts and runtime semantics, with every
Pallas kernel of the ported paths replaced by a hand-written CUDA
kernel (``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use).
This package never imports JAX or the JAX package.

Ported so far: the streaming odometry step (``slam.SlamRuntime`` in
odometry mode) with RAFTGMA in test mode and ATDNVO; the keyframe map
(MappingVAE, trained by ``end_odometry``) and relocalisation against it;
loop closure and the pose-graph solve; ATDNVO training, odometry
evaluation and the SLAM demo; flow training; the serving export; GMA's
positional modes; the Kalman and plotting CLIs and the remaining
utilities; the reference checkpoint loader.

  data/       KITTI poses, flow caches and windows, flow file formats
  eval/       trajectory metrics, KITTI trajectory files, plots
  geometry/   SE(3) pose math, the pose-graph solve
  models/     ATDNVO, the GMA flow network, MappingVAE, the factory
              that makes them from a config
  ops/        attention (kernels K1, K4, K5), correlation pyramid and
              window lookups (K2, K3, K2n, K2s, K3t), bilinear sampling,
              convex upsampling, padding, the kernel build and the
              kernels' torch.library ops (atdn::*)
  slam/       runtime state machine and keyframe store
  training/   ATDNVO and MappingVAE training and their losses
  cli/        train_odometry, evaluate_odometry, slam_demo, train_mapping,
              train_flow, evaluate_flow, precompute_flows, kalman, visualize
  utils/      device, precision, timing, profiling and depth helpers
  serving.py  torch.export of the streaming step and the frame encoder
  checkpoint.py  reference .pth -> state_dict
  convert.py  JAX variables -> state_dict
"""

__version__ = "0.1.0"
