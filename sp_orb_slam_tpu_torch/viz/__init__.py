"""Host-side visualization and debug rendering.

The port of the JAX package's viz/ (reference src/viz/viewer.cpp,
frame_drawer.cpp, map_drawer.cpp: a Pangolin window) as offline artifacts
and a live HTTP view: per-frame overlay PNGs with the dust-status colours,
map snapshot renders (`System.set_debug_dir`, `run_vo --debug-dir`) and
`viz.live.LiveViewer` (`run_vo --live-port`).  Numpy, PIL and matplotlib
only; nothing here runs on the device.
"""

from sp_orb_slam_tpu_torch.viz.frame_drawer import draw_frame, save_png
from sp_orb_slam_tpu_torch.viz.map_drawer import draw_map

__all__ = ["draw_frame", "draw_map", "save_png"]
