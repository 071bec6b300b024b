"""Model families of the port: the CNN zoo's builders (``zoo``), the
transformer LM (``transformer``, with its one-device train step), its
KV-cached and paged decoding (``generate``) and the byte-level LM script
(``train_lm``)."""
