"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``launch_counts`` counts CUDA kernel launches by wrapper name: a wrapper
adds one where it launches its kernel and nowhere else, so a run that
resets the counter and reads it afterwards shows which kernels it went
through.  Calls served by a plain version (CPU tensors) are not counted.
"""

import collections

launch_counts: collections.Counter = collections.Counter()
