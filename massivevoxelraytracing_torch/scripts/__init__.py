"""The port's measurement scripts, run as `python -m
massivevoxelraytracing_torch.scripts.<name>`: construct_micro,
hako_kernel_micro, hako_phase_timing, hako_shell_micro and r3_phase_split
(the JAX package's scripts of those names, on the card; `--device cpu`
runs the plain versions at a small size)."""
