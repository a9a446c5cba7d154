"""The reconstruction time in the network reconstruction cell:
``recon_ms``'s reader under a name of its own, so that ndl-recon's
reading has a bound of its own and image-recon's keeps its own."""

from pathlib import Path

from benchport import harness

read = harness.load_metric(Path(__file__).resolve().parents[1],
                           "recon_ms").read
