"""Serving tier of the port: the bucketed executor over a PyTorch
:class:`~poseidon_tpu_torch.core.net.Net` (``executor``), the micro-batcher
(``batcher``), the paged KV pool (``kv_pool``) and the continuous-batching
LLM executor and scheduler (``continuous``), the socket front-end
(``server``) and the client (``client``). Wire protocol and behaviour
follow ``poseidon_tpu/serving``.
"""
