"""The port's model zoo: the families of ``repro.models`` as torch modules,
GQA (gemma-7b and its window variant, h2o-danube-1.8b, chatglm3-6b,
deepseek-67b), MLA with MoE (deepseek-v2-lite-16b, deepseek-v2-236b), the
recurrent families (xlstm-125m's mLSTM and sLSTM, recurrentgemma-2b's
RG-LRU with local attention), the encoder-decoder (whisper-medium: its
encoder and cross-attention cache) and the vision-language backbone
(qwen2-vl-7b: M-RoPE and vision embeddings)."""
