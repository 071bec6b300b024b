"""Model families of the port beyond the prototxt CNNs: the transformer LM
(``transformer``) and its KV-cached and paged decoding (``generate``)."""
