"""Package version + provenance identifiers (reference counterpart:
``include/richdem/common/version.hpp`` — SURVEY.md §2.1)."""

__version__ = "0.1.0"

#: Printed by the CLI banner, mirroring the reference's program_identifier.
PROGRAM_IDENTIFIER = f"richdem_tpu {__version__} (JAX/XLA/Pallas)"
