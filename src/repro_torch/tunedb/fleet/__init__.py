"""The port's tuning fleet (``repro.tunedb.fleet``): a coordinator and
workers over a shared directory, no network and no daemon.

  lease.py        the bus: job files claimed by atomic rename, heartbeats
                  (mtime), lease expiry, done markers, ``DRAIN``
  worker.py       claim -> tune (on the card by default) -> append to a
                  private shard store (``<store>.shards/<worker_id>.jsonl``)
  coordinator.py  publish jobs, requeue crashed workers' jobs, merge the
                  shards into the parent store behind an optional sentry
                  gate, retrain, publish plans, write a FleetReport

CLI: ``python -m repro_torch.tunedb fleet {start,worker,status,drain,
route}``.  Serving reaches it through ``ServeConfig(retune_fleet=...)``:
the retune controller publishes its epoch's shapes as jobs and swaps after
the merge.
"""

from .coordinator import Coordinator, FleetReport, run_fleet_inline
from .lease import FleetDir, FleetJob, job_id_for
from .worker import Worker, WorkerReport, default_worker_id

__all__ = [
    "Coordinator", "FleetReport", "run_fleet_inline",
    "FleetDir", "FleetJob", "job_id_for",
    "Worker", "WorkerReport", "default_worker_id",
]
