"""Dataset writing, footer metadata and row-group indexing of the port."""

from abc import ABCMeta, abstractmethod


class RowGroupIndexerBase(metaclass=ABCMeta):
    """Base class of row-group indexers: each maps the values of its
    columns to the ordinals of the row-groups that hold them."""

    @property
    @abstractmethod
    def index_name(self):
        """Unique name of this index."""

    @property
    @abstractmethod
    def column_names(self):
        """Column names needed to build the index."""

    @property
    @abstractmethod
    def indexed_values(self):
        """All values the index can look up."""

    @abstractmethod
    def get_row_group_indexes(self, value_key):
        """Row-group ordinals containing ``value_key``."""

    @abstractmethod
    def build_index(self, decoded_rows, piece_index):
        """Consume the decoded rows of one row-group and update the index."""
