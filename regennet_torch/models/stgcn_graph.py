"""Skeleton graph of the ST-GCN action classifier (the port's numpy copy of
regennet_tpu/models/stgcn_graph.py, the layouts the evaluations use).

Layouts: 'smpl' (24 joints and a root-translation node) and 'smplx' (55
and 1), from the body-model kinematic trees; 'smpl_noglobal' (the 23
SMPL joints below the root); 'ntu-rgb+d' (the 25-joint Kinect v2 bone
list, remapped by (i - 2) mod 25 so the root-translation row is the last
node, centre 19), the graph of ACTOR's xyz recognition route, and
'ntu_edge' (its 24-node no-glob variant, centre 2); 'openpose' (15
joints, no translation node, centre joint 1), the skeleton of the
unconstrained HumanAct12 evaluator. The 'spatial' partition strategy
(root / closer / further), the one the classifier uses.
"""

from __future__ import annotations

import numpy as np

from regennet_torch.ops.body_model import SMPL_PARENTS, SMPLX_PARENTS


class Graph:
    def __init__(self, layout="smpl", max_hop=1, dilation=1):
        self.max_hop = max_hop
        self.dilation = dilation
        self.get_edge(layout)
        self.hop_dis = get_hop_distance(self.num_node, self.edge, max_hop=max_hop)
        self.get_adjacency()

    def get_edge(self, layout):
        if layout in ("smpl", "smplx"):
            joints, parents = (24, SMPL_PARENTS) if layout == "smpl" else (55, SMPLX_PARENTS)
            self.num_node = joints + 1
            neighbor_link = [(j, int(parents[j])) for j in range(1, joints)]
            neighbor_link.append((0, joints))  # root rotation <-> translation node
            self.center = 0
        elif layout == "smpl_noglobal":
            self.num_node = 23
            neighbor_link = [(j - 1, int(SMPL_PARENTS[j]) - 1) for j in range(1, 24)
                             if int(SMPL_PARENTS[j]) != 0]
            self.center = 0
        elif layout == "ntu-rgb+d":
            self.num_node = 25
            neighbor_1base = [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
                              (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
                              (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
                              (20, 19), (22, 23), (23, 8), (24, 25), (25, 12)]
            neighbor_link = [((i - 2) % 25, (j - 2) % 25) for i, j in neighbor_1base]
            self.center = 21 - 2
        elif layout == "ntu_edge":
            self.num_node = 24
            neighbor_1base = [(1, 2), (3, 2), (4, 3), (5, 2), (6, 5), (7, 6), (8, 7),
                              (9, 2), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13),
                              (15, 14), (16, 15), (17, 1), (18, 17), (19, 18), (20, 19),
                              (21, 22), (22, 8), (23, 24), (24, 12)]
            neighbor_link = [(i - 1, j - 1) for i, j in neighbor_1base]
            self.center = 2
        elif layout == "openpose":
            # joint order of eval/unconstrained.SMPL_TO_OPENPOSE15
            self.num_node = 15
            neighbor_link = [(4, 3), (3, 2), (2, 1), (7, 6), (6, 5), (5, 1), (1, 0),
                             (14, 13), (13, 12), (12, 8), (11, 10), (10, 9), (9, 8),
                             (8, 1)]
            self.center = 1
        else:
            raise NotImplementedError(f"layout {layout!r} is not ported")
        self.edge = [(i, i) for i in range(self.num_node)] + neighbor_link

    def get_adjacency(self):
        """A [K, V, V]: for each hop, the normalised adjacency split by
        whether a neighbour is as close to the centre, closer, or further."""
        valid_hop = range(0, self.max_hop + 1, self.dilation)
        adjacency = np.zeros((self.num_node, self.num_node))
        for hop in valid_hop:
            adjacency[self.hop_dis == hop] = 1
        normalize_adjacency = normalize_digraph(adjacency)
        A = []
        for hop in valid_hop:
            a_root = np.zeros((self.num_node, self.num_node))
            a_close = np.zeros((self.num_node, self.num_node))
            a_further = np.zeros((self.num_node, self.num_node))
            for i in range(self.num_node):
                for j in range(self.num_node):
                    if self.hop_dis[j, i] == hop:
                        if self.hop_dis[j, self.center] == self.hop_dis[i, self.center]:
                            a_root[j, i] = normalize_adjacency[j, i]
                        elif self.hop_dis[j, self.center] > self.hop_dis[i, self.center]:
                            a_close[j, i] = normalize_adjacency[j, i]
                        else:
                            a_further[j, i] = normalize_adjacency[j, i]
            if hop == 0:
                A.append(a_root)
            else:
                A.append(a_root + a_close)
                A.append(a_further)
        self.A = np.stack(A)


def get_hop_distance(num_node, edge, max_hop=1):
    A = np.zeros((num_node, num_node))
    for i, j in edge:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.zeros((num_node, num_node)) + np.inf
    transfer_mat = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive_mat = np.stack(transfer_mat) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive_mat[d]] = d
    return hop_dis


def normalize_digraph(A):
    Dl = np.sum(A, 0)
    Dn = np.zeros_like(A)
    for i in range(A.shape[0]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-1)
    return np.dot(A, Dn)
