"""TAPIR alone on a clip, timed (`standalone_demo.py`):
`python -m sam_pt_torch.models.tracker.tapir.demo --help`."""
from ..standalone_demo import run

if __name__ == "__main__":
    run("tapir")
