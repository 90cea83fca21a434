"""CLI entry: ``python -m qrag_tpu_torch.serving.app`` (the flags of
``qrag-serve-torch``)."""

from qrag_tpu_torch.serving.http_app import main

if __name__ == "__main__":
    main()
