"""The device's idle time a reconstruction in the network reconstruction
cell: ``recon.idle_ms_per_job``'s reader under a name of its own, which
moves ndl-recon's ``recon_ms.network``."""

from pathlib import Path

from benchport import harness

read = harness.load_metric(Path(__file__).resolve().parents[1],
                           "recon.idle_ms_per_job").read
