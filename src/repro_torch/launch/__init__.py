"""Launchers: ``python -m repro_torch.launch.serve`` (prefill + greedy
decode on the engine's device)."""
