"""The SLAM pipeline: frames, the map, tracking, local mapping, System."""
