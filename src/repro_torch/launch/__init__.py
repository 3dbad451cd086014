"""Drivers of the LM substrate: ``serve`` (batched prefill + greedy
decode).  Training is a later slice."""
