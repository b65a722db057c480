from cpuvox_tpu_torch.bench.entry import main
if __name__ == "__main__":
    raise SystemExit(main())
