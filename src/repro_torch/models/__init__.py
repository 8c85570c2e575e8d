"""The LM substrate's models (`repro.models` on tensors): parameter specs
and init, the decoder's layers, MoE and Mamba2 blocks, and the model."""
