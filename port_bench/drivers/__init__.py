"""One driver a traffic kind: ``run(run) -> dict`` (see ``port_bench.run``)."""
