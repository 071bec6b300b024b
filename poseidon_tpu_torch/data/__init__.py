"""Host-side data plane of the port: LMDB records -> Datum -> transform ->
prefetched numpy batches (``poseidon_tpu/data``'s Python source path)."""
