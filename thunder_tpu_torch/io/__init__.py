from .mrc import read_mrc, write_mrc, read_stack_slices, MrcHeader
from .thu import read_thu, write_thu, ThuColumns
