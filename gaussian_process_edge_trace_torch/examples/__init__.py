"""Runnable examples, the counterparts of the repo's ``examples/*.py``:
``python -m gaussian_process_edge_trace_torch.examples.<name>`` with
``demo``, ``serving``, ``sequence``, ``checkpoint_resume`` or
``multichip``. Each takes ``--device`` (``cuda`` by default)."""
