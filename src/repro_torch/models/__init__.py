"""The port's model zoo: the attention decoders of ``repro.models`` as
torch modules, GQA (gemma-7b and its window variant, h2o-danube-1.8b,
chatglm3-6b, deepseek-67b) and MLA with MoE (deepseek-v2-lite-16b,
deepseek-v2-236b).  Other families are refused when a model is built
(``transformer.check_supported``)."""
