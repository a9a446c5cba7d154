"""The device's idle share in reconstruction in the network
reconstruction cell: ``device.idle_pct.recon``'s reader under a name of
its own, which moves ndl-recon's ``recon_ms.network``."""

from pathlib import Path

from benchport import harness

read = harness.load_metric(Path(__file__).resolve().parents[1],
                           "device.idle_pct.recon").read
