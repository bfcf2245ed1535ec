"""Batched game runtime of the port: ECS state, collision, the step."""
