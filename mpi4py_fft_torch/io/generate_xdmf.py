"""XDMF generation for HDF5 snapshot files.

Copy of ``mpi4py_fft_tpu/io/generate_xdmf.py`` (pure h5py and text; the
port keeps its own so that it imports nothing of the JAX package): a
behavioral port of the reference post-processor
(reference: mpi4py_fft/io/generate_xdmf.py:102-283): scans an HDF5 file
written by :class:`.HDF5File`, groups the 2-D/3-D scalar datasets by
timestep and slice configuration, and emits one XDMF file per slice
configuration so ParaView/VisIt can visualize the time series.  Supports
both uniform domains (ORIGIN_DXDY(Z) geometry over (Co)RectMesh) and stored
meshes (VXVYVZ geometry over RectMesh), 2-D slices embedded in 3-D domains,
and the paraview/visit axis-order convention switch.
"""
import copy

import numpy as np

__all__ = ('generate_xdmf',)

_XDMF_TEMPLATE = """<?xml version="1.0" encoding="utf-8"?>
<Xdmf xmlns:xi="http://www.w3.org/2001/XInclude" Version="2.1">
  <Domain>
    <Grid Name="Structured Grid" GridType="Collection" CollectionType="Temporal">
      <Time TimeType="List"><DataItem Format="XML" Dimensions="{nt}"> {times} </DataItem></Time>
      {grids}
    </Grid>
  </Domain>
</Xdmf>
"""


def _fmt_grid(geometry, topology, attributes):
    return ("""<Grid GridType="Uniform">
        %s
        %s
        %s
      </Grid>
      """ % (geometry, topology, attributes))


def _geometry_uniform(origins, deltas):
    """ORIGIN_DXDY(Z) geometry for a uniform grid."""
    dim = len(origins)
    tag = "ORIGIN_DXDY" if dim == 2 else "ORIGIN_DXDYDZ"
    o = " ".join(str(v) for v in origins)
    d = " ".join(str(v) for v in deltas)
    return ("""<Geometry Type="%s">
          <DataItem Format="XML" NumberType="Float" Dimensions="%d">
            %s
          </DataItem>
          <DataItem Format="XML" NumberType="Float" Dimensions="%d">
            %s
          </DataItem>
        </Geometry>""" % (tag, dim, o, dim, d))


def _geometry_mesh(h5filename, group, prec, axes):
    """VXVYVZ geometry.  ``axes`` is a list (slowest..fastest of the XDMF
    item order, i.e. z,y,x) of either ('dataset', coord_name, length) or
    ('value', position) entries."""
    items = []
    for ax in axes:
        if ax[0] == 'dataset':
            _, cname, length = ax
            items.append(
                """<DataItem Format="HDF" NumberType="Float" Precision="%d" Dimensions="%d">
            %s:%s/mesh/%s
          </DataItem>""" % (prec, length, h5filename, group, cname))
        else:
            items.append(
                """<DataItem Format="XML" NumberType="Float" Precision="8" Dimensions="1">
            %s
          </DataItem>""" % (ax[1],))
    return ("""<Geometry Type="VXVYVZ">
          %s
        </Geometry>""" % "\n          ".join(items))


def _topology(dims, uniform):
    co = 'Co' if uniform else ''
    if len(dims) == 2:
        dims = [1] + list(dims)
    d = " ".join(str(v) for v in dims)
    return '<Topology Dimensions="%s" Type="3D%sRectMesh"/>' % (d, co)


def _attribute(dset_path, h5filename, dims, prec):
    name = dset_path.split("/")[0]
    if len(dims) == 2:
        dims = [1] + list(dims)
    d = " ".join(str(v) for v in dims)
    return ("""<Attribute Name="%s" Center="Node">
          <DataItem Format="HDF" NumberType="Float" Precision="%d" Dimensions="%s">
            %s:/%s
          </DataItem>
        </Attribute>
        """ % (name, prec, d, h5filename, dset_path))


def _collect_datasets(f):
    """Scalar 2-D/3-D datasets grouped as {ndim: {tstep: [paths]}}."""
    import h5py
    keys = []
    f.visit(keys.append)
    datasets = {2: {}, 3: {}}
    for key in keys:
        root = key.split('/')[0]
        if f[root].attrs.get('rank', 0) > 0:
            continue
        if not isinstance(f[key], h5py.Dataset):
            continue
        if 'mesh' in key or 'domain' in key or 'Vector' in key:
            continue
        parts = key.split("/")
        try:
            tstep = int(parts[-1])
            ndim = int(parts[1][0])
        except ValueError:
            continue
        if ndim in (2, 3):
            datasets[ndim].setdefault(tstep, []).append(key)
    return datasets


def generate_xdmf(h5filename, periodic=True, order='paraview'):
    """Generate XDMF files decorating ``h5filename``
    (reference: io/generate_xdmf.py:102-283).

    periodic: affects the dx computation for uniform domains (dx = L/N for
    periodic, L/(N-1) otherwise).  order: 'paraview' or 'visit' — the two
    tools expect opposite mesh-axis order for 2-D slices.
    """
    import h5py
    assert order.lower() in ('paraview', 'visit')
    f = h5py.File(h5filename, 'a')
    datasets = _collect_datasets(f)

    if periodic is True:
        per = [0] * 5
    elif periodic is False:
        per = [1] * 5
    else:
        assert isinstance(periodic, (tuple, list))
        per = list(np.array(np.invert(np.asarray(periodic, bool)), int))

    for ndim, dsets in datasets.items():
        if not dsets:
            continue
        timesteps = sorted(dsets.keys(), key=int)
        times_str = " ".join(str(t) for t in timesteps) + " "
        first = dsets[timesteps[0]][0]
        datatype = f[first].dtype
        assert datatype.char not in 'FDG', \
            "Cannot use generate_xdmf to visualize complex data."
        prec = 4 if datatype == np.dtype('float32') else 8

        geometry, topology, grids = {}, {}, {}
        dims_of = {}
        for name in dsets[timesteps[0]]:
            group = name.split('/')[0]
            slices = name.split("/")[2] if 'slice' in name else 'whole'
            if slices in geometry:
                continue
            N = list(f[name].shape)
            full_shape = list(f[group].attrs.get('shape'))
            perx = copy.copy(per)

            # which global axes survive the slice, and where a fixed index
            # sits for a 2-D slice of a 3-D field
            fixed_axis, fixed_index = None, 0
            if slices == 'whole':
                axes_kept = list(range(ndim))
            else:
                axes_kept = []
                for i, token in enumerate(slices.split("_")):
                    if token == 'slice':
                        axes_kept.append(i)
                    elif len(full_shape) == 3:
                        fixed_axis, fixed_index = i, int(token)
            embed_3d = (ndim == 3) or (fixed_axis is not None)
            dims_of[slices] = N

            has_domain = 'domain' in f[group]
            if has_domain:
                dom = [tuple(f[f"{group}/domain/x{i}"][:])
                       for i in range(len(full_shape))]
                if not embed_3d:
                    i, j = axes_kept
                    if order.lower() == 'paraview':
                        o = [dom[i][0], dom[j][0]]
                        d = [dom[i][1] / (N[0] - perx[i]),
                             dom[j][1] / (N[1] - perx[j])]
                    else:
                        o = [dom[j][0], dom[i][0]]
                        d = [dom[j][1] / (N[0] - perx[j]),
                             dom[i][1] / (N[1] - perx[i])]
                    geometry[slices] = _geometry_uniform(o, d)
                else:
                    axes3 = list(axes_kept)
                    N3 = list(N)
                    if fixed_axis is not None:
                        axes3.insert(fixed_axis, fixed_axis)
                        N3.insert(fixed_axis, 1)
                        perx[fixed_axis] = 0
                    o = [dom[a][0] for a in axes3]
                    d = [dom[a][1] / (n - p) for a, n, p in
                         zip(axes3, N3, [perx[a] for a in axes3])]
                    if fixed_axis is not None:
                        k = fixed_axis
                        pos = (dom[k][0] + dom[k][1] /
                               (full_shape[k] - perx[k]) * fixed_index)
                        o[k] = pos
                        d[k] = pos
                    dims_of[slices] = N3
                    geometry[slices] = _geometry_uniform(o, d)
                topology[slices] = _topology(dims_of[slices], uniform=True)
            else:
                coords = [f"x{a}" for a in axes_kept]
                if not embed_3d:
                    if order.lower() == 'paraview':
                        axes_spec = [('dataset', coords[0], N[0]),
                                     ('dataset', coords[1], N[1])]
                    else:
                        axes_spec = [('dataset', coords[1], N[1]),
                                     ('dataset', coords[0], N[0])]
                    axes_spec.append(('value', 0))
                    geometry[slices] = _geometry_mesh(
                        h5filename, group, prec, axes_spec)
                else:
                    N3 = list(N)
                    entries = [('dataset', c, n) for c, n in zip(coords, N)]
                    if fixed_axis is not None:
                        pos = f[f"{group}/mesh/x{fixed_axis}"][fixed_index]
                        entries.insert(fixed_axis, ('value', pos))
                        N3.insert(fixed_axis, 1)
                    # XDMF VXVYVZ lists fastest axis (x) first
                    dims_of[slices] = N3
                    geometry[slices] = _geometry_mesh(
                        h5filename, group, prec, entries[::-1])
                topology[slices] = _topology(dims_of[slices], uniform=False)
            grids[slices] = ''

        # one grid per timestep per slice configuration
        for tstep in timesteps:
            attrs = {}
            for path in dsets[tstep]:
                slices = path.split("/")[2] if 'slice' in path else 'whole'
                attrs.setdefault(slices, '')
                attrs[slices] += _attribute(path, h5filename,
                                            dims_of[slices], prec)
            for slices, a in attrs.items():
                grids[slices] += _fmt_grid(geometry[slices],
                                           topology[slices], a.rstrip())

        for slices, g in grids.items():
            if slices == 'whole':
                fname = h5filename[:-3] + ".xdmf"
            else:
                fname = h5filename[:-3] + "_" + slices + ".xdmf"
            with open(fname, "w") as xfl:
                xfl.write(_XDMF_TEMPLATE.format(
                    nt=len(timesteps), times=times_str, grids=g.rstrip()))
    f.close()


if __name__ == "__main__":
    import sys
    generate_xdmf(sys.argv[-1])
