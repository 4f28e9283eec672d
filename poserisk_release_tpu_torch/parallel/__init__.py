"""Mesh parallelism of the pose core over torch.distributed.

Port of the JAX package's parallel/ package. JAX drives a device mesh from
one process; the port runs one process per rank (multi-controller, like
JAX's multi-host mode) over torch.distributed process groups, with a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the JAX axis
names: ``data`` outermost, then ``stage``, ``expert``, ``model``,
``spatial``.

  * mesh.py: the data axis (pad, this rank's rows, the all-gather back)
    and the spatial axis's row partition and halo exchanges;
  * distributed.py: joining a process group, the rank's device, spawning
    ranks;
  * collectives.py: the one module that calls torch.distributed
    collectives (and stages CUDA tensors through the host on gloo);
  * spmd.py: the config -> mesh rule, Megatron tensor parallelism of the
    HMR (``model``) and the HMR over crop rows (``spatial``);
  * pipeline.py: the GPipe pipeline of the HMR over ``stage``;
  * expert.py: the gendered SMPL models as experts over ``expert``.

Every rank runs the host side (decode, detection, SORT, chunking)
identically; only the pose core takes the mesh. Importing this package
creates no process group.
"""
