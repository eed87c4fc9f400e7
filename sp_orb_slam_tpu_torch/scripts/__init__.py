"""The port's user tools, the counterparts of the JAX package's `scripts/`.

Each runs as `python -m sp_orb_slam_tpu_torch.scripts.<name>`, on the card
unless `--device cpu` is given, keeps its JAX script's flags, JSON keys and
defaults (each deliberate difference is stated in its module docstring),
and exposes its steps as plain functions:

- `fit_vlad_centroids`: the loop closer's NetVLAD codebook for a SuperPoint
  checkpoint (spherical k-means, then alpha / residual / mode selection on a
  held-out room);
- `validate_weights`: a checkpoint's descriptor distances and init-matcher
  precision against the rendered room's ray cast;
- `vlad_rendered_stats`: the revisit / distinct / adjacent similarity
  structure the loop detector consumes;
- `replay_degenerate`: the turn-apex replay with the depth filter on and
  off;
- `accuracy_sweep`: the N-seed synthetic-rail accuracy gate.
"""
