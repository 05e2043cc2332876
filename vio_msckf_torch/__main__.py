from vio_msckf_torch.cli import main

raise SystemExit(main())
