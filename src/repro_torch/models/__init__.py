"""The LM substrate's model families: dense, vlm, moe and audio (attention
with KV caches, GShard MoE), hybrid (Mamba2 with a shared attention block)
and ssm (xLSTM); the model stacks and their step functions."""
