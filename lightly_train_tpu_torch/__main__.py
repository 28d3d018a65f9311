from lightly_train_tpu_torch._cli import main

if __name__ == "__main__":
    raise SystemExit(main())
