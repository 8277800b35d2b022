"""Traffic of the benchmark: the scenario families' nominal instances
(frozen copies of the port's ``scenarios/builders.py``), their
randomizers (frozen copies of ``scenarios/batch.py``) and the one general
generator that reads a traffic mix (a ``<name>.json`` file beside this
one) and makes a batch of instances from ``--seed``."""
