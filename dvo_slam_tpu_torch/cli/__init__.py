"""Command-line drivers of the port: the batch benchmark (the dvo_benchmark
replacement, after ``dvo_slam_tpu.cli``)."""
