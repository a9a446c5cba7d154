"""The fixed-sweep coder's share of its roofline in the network
reconstruction cell: ``coder_roofline.recon``'s reader under a name of
its own, which moves ndl-recon's ``recon_ms.network``."""

from pathlib import Path

from benchport import harness

read = harness.load_metric(Path(__file__).resolve().parents[1],
                           "coder_roofline.recon").read
