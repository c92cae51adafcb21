#!/bin/bash
# Run the test suite on the local CPU (8 virtual devices, x64); tests
# marked gpu skip there (JAX_PLATFORMS=cuda,cpu ... -m gpu runs them).
if [ $# -eq 0 ]; then set -- -x -q; fi
exec env JAX_PLATFORMS=cpu python -m pytest tests/ "$@"
