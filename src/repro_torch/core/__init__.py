"""Fed-TGAN's protocol pieces: the §4.1 encoder initialization
(``encoding``), the §4.2 divergences and weighting (``divergence``,
``weighting``), the per-leaf merge oracle (``aggregation``), bytes on the
wire (``comm_model``) and the ``run_federated`` driver
(``architectures``)."""
