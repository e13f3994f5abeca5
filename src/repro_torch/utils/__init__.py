"""Tooling of the port: the communication audit
(:mod:`repro_torch.utils.comm_audit`)."""
