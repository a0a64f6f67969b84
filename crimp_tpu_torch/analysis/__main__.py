from crimp_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
