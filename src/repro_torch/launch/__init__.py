"""Launchers: ``python -m repro_torch.launch.serve`` (prefill + greedy
decode on the engine's device) and ``python -m repro_torch.launch.train``
(the training loop, checkpointed through ForkBase)."""
