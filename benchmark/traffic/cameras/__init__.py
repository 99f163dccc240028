"""Camera kinds, one module a kind: ``pinhole(cam, frame_hw, n_frames,
place, n_streams)`` → (n_frames, 4, 2) pinhole corners of one stream."""
