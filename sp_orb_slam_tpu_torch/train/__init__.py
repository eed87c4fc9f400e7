"""Training of the SuperPoint frontend on rendered rooms
(train/superpoint_train.py)."""
