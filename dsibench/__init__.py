"""dsibench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m dsibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own that the harness finds by the name in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json`` and ``metrics/<metric>.py``; a configuration names
its runner (``runners/<runner>.py``) and its plain reference
(``reference/<reference>.py``).  Nothing here imports JAX or the JAX
package, and the plain references import nothing of ``repro_torch``.
"""
