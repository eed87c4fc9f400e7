"""SE(3), the camera model, triangulation and the two-view bootstrap."""
