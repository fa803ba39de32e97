"""Runtime services of the port: KV-cache snapshots (``kvstore``) and
numeric-fault checks (``faults``), over the port's trees (see ``tree``)."""
