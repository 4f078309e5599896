"""Process meshes for sharded serving and pod-axis training."""
