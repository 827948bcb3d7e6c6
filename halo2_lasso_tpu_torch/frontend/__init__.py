"""Circuit-builder frontend (the port of halo2_lasso_tpu/frontend/): columns,
selectors, gates, logup and Lasso lookups, copy constraints and witness
phases with challenges, built into a ``PlonkishCircuitInfo`` and a
``PlonkishCircuit`` for the port's HyperPlonk (``builder.py``), and the ARX
chain circuit built with it (``arx.py``)."""
