"""Training of the port's LMs: AdamW with the JAX package's
mixed-precision rules (``optimizer``), the train and eval steps
(``steps``) and flat-npz checkpoints (``checkpoint``)."""
