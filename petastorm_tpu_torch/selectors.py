"""Row-group selectors: coarse selection through the footer's row-group
indexes (counterpart of ``petastorm_tpu/selectors.py``). A reader given
``rowgroup_selector=`` keeps only the row-groups the selector returns."""

from abc import ABCMeta, abstractmethod


class RowGroupSelectorBase(metaclass=ABCMeta):
    @abstractmethod
    def get_index_names(self):
        """Names of the indexes this selector needs."""

    @abstractmethod
    def select_row_groups(self, index_dict):
        """Set of row-group ordinals to read, given ``{name: indexer}``."""


class SingleIndexSelector(RowGroupSelectorBase):
    """Row-groups holding any of the given values in one index."""

    def __init__(self, index_name, values_list):
        self._index_name = index_name
        self._values = list(values_list)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        indexer = index_dict[self._index_name]
        selected = set()
        for value in self._values:
            selected |= set(indexer.get_row_group_indexes(value))
        return selected


class IntersectIndexSelector(RowGroupSelectorBase):
    """Row-groups selected by every one of the child selectors."""

    def __init__(self, single_index_selectors):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        names = []
        for s in self._selectors:
            names.extend(s.get_index_names())
        return names

    def select_row_groups(self, index_dict):
        sets = [s.select_row_groups(index_dict) for s in self._selectors]
        return set.intersection(*sets) if sets else set()


class UnionIndexSelector(RowGroupSelectorBase):
    """Row-groups selected by any of the child selectors."""

    def __init__(self, single_index_selectors):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        names = []
        for s in self._selectors:
            names.extend(s.get_index_names())
        return names

    def select_row_groups(self, index_dict):
        result = set()
        for s in self._selectors:
            result |= s.select_row_groups(index_dict)
        return result
