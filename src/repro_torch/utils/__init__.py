"""Tooling of the port: the communication audit
(:mod:`repro_torch.utils.comm_audit`), the dispatch trace
(:mod:`repro_torch.utils.dispatch_trace`) and the roofline terms
(:mod:`repro_torch.utils.roofline`)."""
