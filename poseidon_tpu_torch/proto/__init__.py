"""Caffe prototxt parsing and typed messages, and the wire formats the
serving slice speaks (the port's own copies of ``poseidon_tpu/proto``)."""
