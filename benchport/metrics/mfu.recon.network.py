"""The reconstruction's share of the card's float32 peak in the network
reconstruction cell: ``mfu.recon``'s reader under a name of its own,
which moves ndl-recon's ``recon_ms.network``."""

from pathlib import Path

from benchport import harness

read = harness.load_metric(Path(__file__).resolve().parents[1],
                           "mfu.recon").read
