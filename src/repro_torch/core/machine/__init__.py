from repro_torch.core.machine.model import (DBEntry, MachineModel, pressure_uops,
                                            uniform, uops_entry)
from repro_torch.core.machine.window import WindowParams
from repro_torch.core.machine.csx import cascade_lake
from repro_torch.core.machine.n1 import neoverse_n1
from repro_torch.core.machine.tx2 import thunderx2
from repro_torch.core.machine.zen import zen
from repro_torch.core.machine.zen2 import zen2

__all__ = ["DBEntry", "MachineModel", "WindowParams", "pressure_uops",
           "uniform", "uops_entry", "cascade_lake", "neoverse_n1",
           "thunderx2", "zen", "zen2"]
