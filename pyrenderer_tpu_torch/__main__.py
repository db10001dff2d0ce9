import sys

from pyrenderer_tpu_torch.render.cli import main

sys.exit(main())
