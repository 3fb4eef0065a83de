"""`python -m gpu_ray_tracing` entry point."""

import sys

from gpu_ray_tracing.cli import main

sys.exit(main())
