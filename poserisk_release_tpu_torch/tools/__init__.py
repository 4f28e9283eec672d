"""Experiment entry points of the port: the A/B measurements of kernels K5
(exp_fused_stage) and K3 (exp_window_crop), counterparts of the JAX
package's tools/exp_fused_stage.py and tools/exp_window_crop.py. Run as
`python -m poserisk_release_tpu_torch.tools.<name>`; chip_smoke.py calls
their functions."""
