"""Drivers of the LM substrate: ``serve`` (batched prefill + greedy
decode) and ``train`` (the training loop with checkpoints, resume, the
straggler watchdog and failure injection), and ``mesh`` (the production
mesh's shape and the host's ``DeviceMesh``)."""
