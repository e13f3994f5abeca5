"""Baseline algorithms the paper compares against (in PyTorch):

gilbert        -- Gilbert algorithm for polytope distance (hard margin)
mdm            -- Mitchell-Demyanov-Malozemov min-norm-point (related work)
qp_nusvm       -- projected-gradient QP for RC-Hull (NuSVC stand-in)
pegasos        -- primal SGD for C-SVM (LinearSVC stand-in)
dist_gilbert   -- distributed Gilbert (Liu et al. 16) with comm counting
hogwild        -- stale-gradient simulation of HOGWILD! (semantic port)

Each is the JAX package's algorithm as a host loop of torch ops: a chunk
of iterations reads nothing back from the device, and each ``solve``
reads its history once a chunk.  None reaches a hand-written kernel (the
JAX package's are plain ``jnp`` too): on the card they run PyTorch's own
ops.  Every ``solve`` runs on the card unless given ``device="cpu"``.
"""
