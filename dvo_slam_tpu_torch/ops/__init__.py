"""Tensor ops of the port: SE(3), camera, pyramids, sampling, robust
statistics, the 6x6 solve and the fused statistics (kernel + plain twin)."""
