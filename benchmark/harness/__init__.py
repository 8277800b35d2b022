"""The benchmark harness of the PyTorch/CUDA port: loading cells by name
(``cells``), driving the port (``program``), the timed window
(``runner``), the traced run's record (``trace``), the output check
against the plain reference (``check``) and the frozen yardsticks
(``yardstick``)."""
