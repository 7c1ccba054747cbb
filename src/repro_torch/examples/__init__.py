"""The JAX package's crypto examples (``examples/*.py``) on the port.

Each module runs on ``cuda`` (``--device cpu`` runs the kernels' plain
versions) and keeps its demo in ``main(argv=None)``, which returns a summary
of what it checked; importing a module runs nothing.  Every check raises on
a failure.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.mixed_workload
    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_sequencer
    PYTHONPATH=src python -m repro_torch.examples.online_serving
    PYTHONPATH=src python -m repro_torch.examples.cluster_serving [--hosts 3]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--inject-fault]

``EXAMPLES`` lists the crypto examples; ``train_lm``'s ``main`` returns the
finished training loop.
"""
import argparse

EXAMPLES = ("quickstart", "mixed_workload", "multi_tenant_sequencer",
            "online_serving", "cluster_serving")


def check(cond, what: str):
    """Raise on a failed check (an ``assert`` would vanish under -O)."""
    if not cond:
        raise AssertionError(what)


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser: its docstring's first line and
    ``--device``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    return ap
