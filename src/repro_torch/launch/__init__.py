from .mesh import dp_axes, make_host_mesh, make_production_mesh, tp_axis
