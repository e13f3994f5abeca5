"""Launching the port: the clients of Algorithm 4 as processes and the
production layouts (:mod:`repro_torch.launch.mesh`), the input shapes
(:mod:`~repro_torch.launch.shapes`), the input specs, sharding rules and
step constructors (:mod:`~repro_torch.launch.specs`), the dry-run
(:mod:`~repro_torch.launch.dryrun`) and the training launcher
(:mod:`~repro_torch.launch.train`)."""
