"""`python -m advoc_tpu_torch.serve`: the TCP streaming vocoder server (cli.py)."""

from advoc_tpu_torch.serve.cli import main

if __name__ == "__main__":
    main()
