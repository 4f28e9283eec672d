"""The training side of the port: losses, optimizers and schedules with the
JAX package's (optax) update rules, the SPIN fine-tuning step on one device
or over a torch.distributed mesh (data and model axes), dataset helpers and
training plots."""
