"""The port's model zoo: the dense GQA decoders of ``repro.models``
(gemma-7b and its window variant, h2o-danube-1.8b, chatglm3-6b,
deepseek-67b) as torch modules.  Other families are refused when a model
is built (``transformer.check_supported``)."""
