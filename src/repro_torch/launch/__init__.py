"""Process groups of the port: the clients of Algorithm 4 as processes
(:mod:`repro_torch.launch.mesh`)."""
