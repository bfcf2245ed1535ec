"""Device parallelism: pure data parallelism over game instances
(bonnie32_tpu/parallel/)."""
