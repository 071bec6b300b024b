"""Training and evaluation steps, on one device or data-parallel over
``torch.distributed`` (``trainer.py``), the data group (``mesh.py``) and
the gradient-communication strategies, DWBP buckets and SFB
(``strategies.py``)."""
