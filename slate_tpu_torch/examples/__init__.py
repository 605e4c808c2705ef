"""The examples of slate_tpu_torch (port of examples/): ex01-ex14, SLATE's
tour of the library, each a module with ``main(device)``; ``python -m
slate_tpu_torch.examples.run_all`` runs them all (see run_all)."""
