"""Drivers of the LM substrate: ``serve`` (batched prefill + greedy
decode) and ``train`` (the training loop with checkpoints, resume, the
straggler watchdog and failure injection), ``mesh`` (the production
mesh's shape, the host's ``DeviceMesh`` and fake worlds), and the dry run:
``dryrun`` (one step of a cell as one device of the production mesh),
``op_cost`` (the per-device operation counter) and ``roofline`` (the
H100 terms)."""
