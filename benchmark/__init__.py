"""The benchmark of ``poseidon_tpu_torch``: CNN training cells run through
the port's ``train`` command on NVIDIA cards (``run.py``; ``README.md``)."""
