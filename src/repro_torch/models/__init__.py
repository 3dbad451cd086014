"""The LM substrate's attention families (dense, vlm, moe, audio): layers,
attention with KV caches, GShard MoE, the model stacks and their step
functions.  The recurrent families (hybrid, ssm) are a later slice."""
