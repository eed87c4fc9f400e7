"""PyTorch + CUDA port of sp_orb_slam_tpu for NVIDIA Hopper (H100).

The JAX package `sp_orb_slam_tpu` is the reference; this package imports
nothing of it and nothing of JAX.  Ported: the learned frontend
(`extractor.make_extractor`), the init matcher
(`ops.cuda_match.match_init_batch`), SLAM (`slam.system.System`, `run_vo`)
with loop closing, the online mode and multi-stream serving
(`slam.fleet.StreamFleet`), the batch evaluation (`evaluate`), SuperPoint
training (`train.superpoint_train`), the viewer (`viz`: debug dumps and the
live HTTP viewer), the stream mesh (`parallel.mesh`) and the user tools
(`scripts`: the NetVLAD codebook fit, checkpoint validation, the VLAD
statistics, the degenerate replay, the accuracy sweep), with the seven
TPU kernels as hand-written CUDA kernels in `csrc/` (built on first use by
`ops/_build.py`).
Entry points run on the card unless the caller passes `device="cpu"`.
"""
