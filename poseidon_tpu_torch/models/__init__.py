"""Model families of the port beyond the prototxt CNNs: the transformer LM
(``transformer``, with its one-device train step), its KV-cached and paged
decoding (``generate``) and the byte-level LM script (``train_lm``)."""
