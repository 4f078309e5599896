"""Process meshes for sharded serving and pod-axis training, and the
launch dry run: inputs on ``meta``, the layout over the production
meshes, the step's counts and the roofline on the H100."""
