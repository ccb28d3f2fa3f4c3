"""``repro_torch.analysis`` -- the runtime sanitizer of the port.

Port of the conservation checks of ``repro.analysis.sanitizer``
(``check_engine_conservation``, ``check_server_conservation``,
``assert_conserved``, ``sanitize_enabled``, ``SanitizerError``). The
reference's static linter (``python -m repro.analysis``) runs over this
package too; port-keyed rule tables are ROADMAP item 24.
"""
from repro_torch.analysis.sanitizer import (SanitizerError, assert_conserved,
                                            check_engine_conservation,
                                            check_server_conservation,
                                            sanitize_enabled)

__all__ = ["SanitizerError", "assert_conserved", "check_engine_conservation",
           "check_server_conservation", "sanitize_enabled"]
